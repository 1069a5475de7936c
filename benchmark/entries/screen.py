"""Entry `screen`: the genome-wide long-range screen, the port's
`fast_lr_topk`, called again and again on one prepared state.

Traffic parameters: `topk`, `precision_terms`, `sr_dist` (optional; the
configuration's by default).  Each call ends in its own pull of the
top-k to the host.  A call's work is every SNP pair of the input."""

from __future__ import annotations

from benchmark.reference import screen as reference
from benchmark.reference.mi import Sites


class State:
    def __init__(self, inputs, config, traffic, device):
        from ldweaver_tpu_torch.core.snp_tensor import SnpData, derive_site_stats
        from ldweaver_tpu_torch.parallel.fast_sweep import prepare_fast_sweep

        self.inputs, self.config, self.traffic = inputs, config, traffic
        self.sr_dist = int(traffic.get("sr_dist", config["sr_dist"]))
        self.topk = int(traffic["topk"])
        self.terms = int(traffic["precision_terms"])
        uqe, r = derive_site_stats(inputs.acgtn)
        sd = SnpData(codes=inputs.codes, pos=inputs.pos, g=inputs.g,
                     seq_names=[str(s) for s in range(inputs.nseq)],
                     acgtn_table=inputs.acgtn, uqe=uqe, r=r)
        self.prepared = prepare_fast_sweep(sd, inputs.w, block=int(config["block"]),
                                           device=device)
        self.pairs = inputs.nsnp * (inputs.nsnp - 1) // 2

    def call(self):
        from ldweaver_tpu_torch.parallel.fast_sweep import fast_lr_topk

        return fast_lr_topk(state=self.prepared, sr_dist=self.sr_dist, topk=self.topk,
                            precision_terms=self.terms)


def setup(inputs, config, traffic, device):
    """Prepare the sweep and warm up its shapes with one whole call."""
    state = State(inputs, config, traffic, device)
    state.call()
    return state


def run(state):
    """One call -> its record."""
    pos1, pos2, mi = state.call()
    # the answer depends on the MI of every long-range pair
    return dict(pairs=state.pairs, needed="long_range", answer=(pos1, pos2, mi))


def release(state):
    state.prepared = None


NUMBERS = ("mi_rel_err", "topk_gap", "malformed")


def check(state, records, device):
    """The comparison with the reference of every call's answer ->
    ((name, value, limit) triples, each the worst over the calls; the
    reference's readings; the calls that failed a limit)."""
    inputs, limits = state.inputs, state.traffic["limits"]
    sites = Sites(inputs.codes, inputs.w, device)
    per_call, kth = reference.compare([rec["answer"] for rec in records], sites,
                                      inputs.pos, inputs.g, state.sr_dist, state.topk,
                                      int(state.config["block"]))
    worst = {n: max(c[n] for c in per_call) for n in NUMBERS}
    failed = sum(any(c[n] > limits[n] for n in NUMBERS) for c in per_call)
    return [(n, worst[n], limits[n]) for n in NUMBERS], dict(kth_mi=kth), failed
