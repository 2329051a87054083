"""attn_bwd_roofline: percent of its roofline that the tree-attention
backward reaches in the traced steps. Every backward mode runs one
key-major launch a layer (K3, K10 or K12), so those launches count the
layers; each layer's work is counted once, as the fused dq/dk/dv pass
needs it (``work.attn_bwd_work``), and the time is every backward
kernel's (K11 with K12 under "split"), so the share reads alike whatever
mode runs."""

from work import attn_bwd_work, bound_s


def read(run):
    def bound(tr):
        layers = len(tr.kernels("tree_attn_bwd_kmajor"))
        return layers * bound_s(*attn_bwd_work(run.cfg, *run.batch_work(tr.unit["batch"])))

    return run.kernel_share(("tree_attn_bwd",), bound)
