"""host_syncs_per_it (syncs/it): the warnings of
torch.cuda.set_sync_debug_mode("warn") over one solve, over its
iterations."""


def read(run):
    s = run["stages"].get("syncs")
    if not s or not s["iterations"]:
        return None
    return s["count"] / s["iterations"]
