"""Mean host time of one ``synthesize_batch_async`` call over the measured
window's batches (host clock around each call, tracing off)."""

from portbench.readers import host_mean_ms


def read(seg, run):
    return host_mean_ms(run.get("dispatch_s", []))
