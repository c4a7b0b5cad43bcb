"""Device milliseconds per MD step in NCCL kernels, on the card that
spends the most there (a rank waiting in the samples' gather counts)."""

from harness import trace


def read(run):
    devs = {int(e["args"]["device"]) for e in trace.device_ops(run["trace"])
            if "device" in e.get("args", {})}
    per = [trace.kernel_ms(run["trace"], lambda k: "nccl" in k.lower(), d)
           for d in sorted(devs)]
    if not any(n for _, n in per):
        return None
    return max(ms for ms, _ in per) / run["traced_md_steps"]
