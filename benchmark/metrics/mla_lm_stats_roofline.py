"""mla_lm_stats_roofline: ``lm_stats_roofline`` in a DeepSeek-V3 (MLA)
cell: percent of their roofline that the LM-head statistics kernels reach
in the traced steps, K8 (its partial and merge launches) forward, K9
(dlogits and product launches) backward; a call is counted by its first
kernel, its work from the trie's tokens and the configuration's d and V
(``work_mla.mla_lm_fwd_work``, ``work_mla.mla_lm_bwd_work``)."""

from work import bound_s
from work_mla import mla_lm_bwd_work, mla_lm_fwd_work


def read(run):
    def bound(tr):
        nodes, _ = run.batch_work(tr.unit["batch"])
        return (len(tr.kernels("lm_fwd_partial")) * bound_s(*mla_lm_fwd_work(run.cfg, nodes))
                + len(tr.kernels("lm_bwd_dlogits")) * bound_s(*mla_lm_bwd_work(run.cfg, nodes)))

    return run.kernel_share(("lm_fwd", "lm_bwd"), bound)
