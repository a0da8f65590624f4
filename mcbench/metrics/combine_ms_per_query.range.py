"""Device time of the controller combines (ops whose name holds
bitwise_reduce, among the traced window's top device ops), per query."""


def read(rec):
    dev = rec.get("device")
    if not dev or not rec.get("queries"):
        return None
    times = [s for name, s in dev.get("device_ops", [])
             if "bitwise_reduce" in name]
    if not times:
        return None
    return sum(times) * 1e3 / rec["queries"]
