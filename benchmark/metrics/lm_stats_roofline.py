"""lm_stats_roofline: percent of their roofline that the LM-head
statistics kernels reach in the traced steps: K8 (its partial and merge
launches) forward, K9 (dlogits and product launches) backward; a call is
counted by its first kernel, its work from the trie's tokens
(``work.lm_fwd_work``, ``work.lm_bwd_work``)."""

from work import bound_s, lm_bwd_work, lm_fwd_work


def read(run):
    def bound(tr):
        nodes, _ = run.batch_work(tr.unit["batch"])
        return (len(tr.kernels("lm_fwd_partial")) * bound_s(*lm_fwd_work(run.cfg, nodes))
                + len(tr.kernels("lm_bwd_dlogits")) * bound_s(*lm_bwd_work(run.cfg, nodes)))

    return run.kernel_share(("lm_fwd", "lm_bwd"), bound)
