"""What the per-layer metrics read, shared by their files in `metrics/`.
Each returns None where the run has nothing to read: a roofline or MFU
share is never reported as 0."""
from __future__ import annotations

from portbench import roofline

#: Kernel names (substrings) of the port's hand-written kernels.
STEM_FORWARD = ("p2m_conv_kernel", "p2m_conv_pipelined_kernel")
STEM_DX = ("p2m_bwd_dx_kernel",)
STEM_DW = ("p2m_bwd_dw_partial_kernel",)
STEM_DW_ALL = ("p2m_bwd_dw_partial_kernel", "p2m_bwd_dw_finalize_kernel")
WKV = ("wkv_chunked_kernel",)


def _trace(r):
    return None if r.profiler is None else r.profiler.trace


def launch_ms(r) -> float | None:
    return r.layer.get("launch_ms")


def idle_share(r) -> float | None:
    t = _trace(r)
    if t is None or t.busy_s <= 0.0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)


def _share(r, parts) -> float | None:
    """Σ least time × calls over Σ device time, for (least_s, counted
    names, timed names) parts."""
    t = _trace(r)
    if t is None:
        return None
    least = device = 0.0
    for least_s, counted, timed in parts:
        calls, _ = t.kernel_time(*counted)
        _, secs = t.kernel_time(*timed)
        least += least_s * calls
        device += secs
    return roofline.share_pct(least, device)


def stem_roofline_train(r) -> float | None:
    s = r.layer["stem_least_s"]
    return _share(r, [(s["forward"], STEM_FORWARD, STEM_FORWARD),
                      (s["dx"], STEM_DX, STEM_DX),
                      (s["dw"], STEM_DW, STEM_DW_ALL)])


def stem_roofline_serve(r) -> float | None:
    return _share(r, [(r.layer["stem_least_s"], STEM_FORWARD,
                       STEM_FORWARD)])


def wkv_roofline(r) -> float | None:
    return _share(r, [(r.layer["wkv_least_s"], WKV, WKV)])


def _pct_of_peak(flops_per_s: float | None) -> float | None:
    if not flops_per_s:
        return None
    return 100.0 * flops_per_s / roofline.PEAK_FLOPS


def mfu_tokens(r) -> float | None:
    """2·N FLOPs a token served (N the products' parameters) times the
    tokens a second, over the peak."""
    return _pct_of_peak(2 * r.layer["n_model"] * r.layer["tokens_per_s"])


def mfu_images(r) -> float | None:
    return _pct_of_peak(r.layer["flops_per_image"] * r.layer["images_per_s"])


def mfu_launch(r) -> float | None:
    """The model's FLOPs of one launch over its mean host time."""
    ms = r.layer.get("launch_ms")
    return _pct_of_peak(r.layer["flops_per_launch"] / (ms / 1e3)) \
        if ms else None
