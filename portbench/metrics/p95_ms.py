"""The 95th percentile (nearest rank) of every request's latency in the
window, in ms: host clock from the call to its completion after
``torch.cuda.synchronize()``."""
import math


def read(run):
    lat = sorted(run.window.latencies)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
