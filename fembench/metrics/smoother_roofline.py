"""smoother_roofline (%): one post-smoothing step of the finest level from
a nonzero guess (residual, Schwarz apply and update, whatever implements
them): its least time on the card (fembench/roofline.py) over its
CUDA-event time."""

from fembench import roofline


def read(run):
    s = run["stages"].get("smoother_step_s")
    if not s:
        return None
    f = run["finest"]
    return roofline.share_percent(roofline.smoother_step_work(f), f["itemsize"], s)
