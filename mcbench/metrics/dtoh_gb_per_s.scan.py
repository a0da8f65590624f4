"""Result bytes drained to the host over the device time of the DtoH
copies."""


def read(rec):
    dev = rec.get("device")
    if not dev or not dev["dtoh_s"] or not rec.get("result_bytes"):
        return None
    return rec["result_bytes"] / dev["dtoh_s"] / 1e9
