"""mla_attn_fwd_roofline: percent of its roofline that the tree-attention
forward at MLA's widths (``tree_attn_fwd_mla_kernel<192, 128>``) reaches in
the traced steps: each launch is one layer's attention over the trie, its
work counted from the sequences (``work_mla.mla_attn_fwd_work``); None where
no such kernel ran."""

from work import bound_s
from work_mla import mla_attn_fwd_work

TAG = "tree_attn_fwd_mla"


def read(run):
    def bound(tr):
        return len(tr.kernels(TAG)) * bound_s(*mla_attn_fwd_work(run.cfg, *run.batch_work(tr.unit["batch"])))

    return run.kernel_share((TAG,), bound)
