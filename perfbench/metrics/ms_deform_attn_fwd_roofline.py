"""The sampling kernel's (ms_deform_attn_fwd_kernel) share of its roofline
over the profiled window, in %: the least time of its launches (bytes and
operations of perfbench/counts/deform.py from the reference's sampling
locations) over the device time the profiler gives its launches."""


def read(rec):
    prof, least = rec.get("profile"), rec.get("deform_fwd_least_s")
    if not prof or least is None:
        return None
    t = sum(v for k, v in prof["kernel_s"].items() if "ms_deform_attn_fwd_kernel" in k)
    return 100.0 * least / t if t > 0 else None
