"""mfu_mla.train: percent of the H100's bf16 peak that a DeepSeek-V3 (MLA)
configuration's training steps' model FLOPs take of their wall time:
forward and backward of the trie's tokens, counted from the sequences and
the published config with no recompute (``work_mla.mla_train_flops``: MLA's
projections and products, the dense layers, k routed and the shared
experts, the head), over the untraced steps of a traced run's window, as
``mfu.train`` counts a Qwen3 configuration's."""

from work import PEAK_BF16_FLOPS
from work_mla import mla_train_flops


def read(run):
    units = [u for u in run.untraced() if "batch" in u]
    wall = sum(u["wall_s"] for u in units)
    if not wall:
        return None
    flops = sum(mla_train_flops(run.cfg, *run.batch_work(u["batch"])) for u in units)
    return 100.0 * flops / (wall * PEAK_BF16_FLOPS)
