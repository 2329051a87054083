"""decode_attn_roofline: percent of its roofline that the grouped-decode
attention (K13) reaches in the traced rollout: one launch a layer a decode
step, step t's work counted from the prompts' lengths and t
(``work.decode_work``). A trace that kept fewer launches than the rollout
made is counted at its share of them."""

from work import bound_s, decode_work


def read(run):
    def bound(tr):
        u, L = tr.unit, run.cfg["num_hidden_layers"]
        total = sum(L * bound_s(*decode_work(run.cfg, u["plens"], u["group"], t)) for t in range(u["max_new"] - 1))
        return total * len(tr.kernels("decode_attn_kernel")) / (L * (u["max_new"] - 1))

    return run.kernel_share(("decode_attn_kernel",), bound)
