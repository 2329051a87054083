"""dynamictreeattn_tpu_torch — the PyTorch / CUDA (Hopper) port of dynamictreeattn_tpu.

Rollout sequences that share prefixes are merged into a token trie, flattened
once into a packed DFS layout, and run in one forward and one backward pass
through hand-written tree-masked attention and LM-head statistics kernels for
NVIDIA Hopper (``csrc/``). The JAX package ``dynamictreeattn_tpu`` is the reference;
each module here has one counterpart there.

Subpackages
-----------
tries   : token tries, DFS flattening, block-sparse mask metadata, the
          trie cost features (numpy)
data    : synthetic rollout tries, sequence batch IO (numpy)
ops     : tree-attention and LM-head statistics kernels (forward and
          backward) + plain versions, the trie loss
models  : functional Qwen3 with remat; loading JAX-layout parameters
engine  : tree engine: training step (weighted or a per-sequence loss),
          inference log-probs, dense replay packing
utils   : gradient-parity comparison, profiling and timing
cli     : command lines: run, run_all, compare_grads
examples: GRPO steps and the RL loop (rollout, reward, update)
"""

__version__ = "0.1.0"
