"""dynamictreeattn_tpu_torch — the PyTorch / CUDA (Hopper) port of dynamictreeattn_tpu.

Rollout sequences that share prefixes are merged into a token trie, flattened
once into a packed DFS layout, and run in one forward and one backward pass
through hand-written tree-masked attention and LM-head statistics kernels for
NVIDIA Hopper (``csrc/``). The JAX package ``dynamictreeattn_tpu`` is the reference;
each module here has one counterpart there.

Subpackages
-----------
tries   : token tries, DFS flattening, block-sparse mask metadata (numpy)
data    : synthetic rollout tries (numpy)
ops     : tree-attention and LM-head statistics kernels (forward and
          backward) + plain versions, the trie loss
models  : functional Qwen3 with remat; loading JAX-layout parameters
engine  : tree engine: training step, inference log-probs, dense replay packing
utils   : gradient-parity comparison
"""

__version__ = "0.1.0"
