"""attn_fwd_roofline: percent of its roofline that the tree-attention
forward (K1/K2) reaches in the traced steps: each launch is one layer's
attention over the trie, its work counted from the sequences
(``work.attn_fwd_work``)."""

from work import attn_fwd_work, bound_s


def read(run):
    def bound(tr):
        return len(tr.kernels("tree_attn_fwd")) * bound_s(*attn_fwd_work(run.cfg, *run.batch_work(tr.unit["batch"])))

    return run.kernel_share(("tree_attn_fwd",), bound)
