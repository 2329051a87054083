"""qk_prep_roofline: percent of their roofline that the qk-prep kernels
(K4-K7: per-head norm, RoPE, head-major transpose, forward and backward)
reach in the traced steps. Each layer's forward runs the q and the k/v
kernel as a pair, as does its backward; each pair's bytes are counted from
the trie's tokens (``work.qk_pair_bytes``)."""

from work import PEAK_HBM_BYTES, qk_pair_bytes


def read(run):
    def bound(tr):
        nodes, _ = run.batch_work(tr.unit["batch"])
        fwd, bwd = len(tr.kernels("qk_prep_fwd")), len(tr.kernels("qk_prep_bwd"))
        return (fwd / 2 * qk_pair_bytes(run.cfg, nodes, "fwd") + bwd / 2 * qk_pair_bytes(run.cfg, nodes, "bwd")) \
            / PEAK_HBM_BYTES

    return run.kernel_share(("qk_prep",), bound)
