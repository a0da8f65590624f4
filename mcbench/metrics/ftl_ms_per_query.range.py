"""FTL time inside the window (the union of the session tracer's ftl spans:
copyback realignment, NOT-ready copies), per query; a guard that reads 0
while every predicate stays pair-local."""


def read(rec):
    spans = rec.get("spans", {})
    if "ftl_us" not in spans or not rec.get("queries"):
        return None
    return spans["ftl_us"] / 1e3 / rec["queries"]
