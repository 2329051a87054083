"""mla_attn_bwd_roofline: percent of its roofline that the tree-attention
backward at MLA's widths (K3's ``tree_attn_bwd_kmajor_mla_kernel<192,
128>``, one launch a layer) reaches in the traced steps, each layer's work
counted once as the fused pass needs it (``work_mla.mla_attn_bwd_work``);
None where no such kernel ran."""

from work import bound_s
from work_mla import mla_attn_bwd_work

TAG = "tree_attn_bwd_kmajor_mla"


def read(run):
    def bound(tr):
        return len(tr.kernels(TAG)) * bound_s(*mla_attn_bwd_work(run.cfg, *run.batch_work(tr.unit["batch"])))

    return run.kernel_share((TAG,), bound)
