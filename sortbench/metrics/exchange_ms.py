"""Device time a call of the exchange between cards, on the card that
spends most on it: peer-to-peer copies and the port's exchange kernels
(``csrc/exchange.cu``)."""

from sortbench import trace


def read(run):
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    kernels = trace.matcher(trace.kernel_names(trace.port_csrc(run.cell.root), "exchange.cu"))
    per_card = tr.op_seconds(lambda name: "PtoP" in name or kernels(name))
    worst = max(per_card.values(), default=0.0)
    return 1e3 * worst / tr.calls if worst > 0 else None
