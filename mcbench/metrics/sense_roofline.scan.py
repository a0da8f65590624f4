"""Share of the HBM roofline: the bytes the window's queries need (each
operand wordline's float32 Vth row read once, the result written once;
counted by each query kind's bytes_needed) over 3.35 TB/s, against the
device time of every operation the queries ran on the card (host copies
left out)."""
from mcbench import roofline


def read(rec):
    dev = rec.get("device")
    if not dev or not dev["work_s"] or not rec.get("bytes_needed"):
        return None
    return 100.0 * rec["bytes_needed"] / roofline.HBM_BYTES_PER_S / dev["work_s"]
