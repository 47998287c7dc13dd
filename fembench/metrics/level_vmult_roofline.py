"""level_vmult_roofline (%): the finest float32 level operator's least
time on the card (fembench/roofline.py) over its CUDA-event time."""

from fembench import roofline


def read(run):
    s = run["stages"].get("level_vmult_s")
    if not s:
        return None
    f = run["finest"]
    return roofline.share_percent(roofline.level_vmult_work(f), f["itemsize"], s)
