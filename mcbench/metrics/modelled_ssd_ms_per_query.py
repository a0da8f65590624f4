"""The session ledger's makespan over the window (reset at its start), per
query completed: the time the paper's SSD would take, modelled, not
measured."""


def read(rec):
    if not rec["queries"]:
        return None
    return rec["makespan_us"] / 1e3 / rec["queries"]
