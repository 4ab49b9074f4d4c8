"""``serve.d2h_memcpy_ms``'s reader on synthetic records: the device time
of the profiled window's ``Memcpy DtoH`` activities a frame, nothing else,
and None where there is nothing to read."""

import pytest

from perfbench import manifest

KERNEL_S = {"Memcpy DtoH (Device -> Pageable)": 0.006, "Memcpy DtoH (Device -> Pinned)": 0.002,
            "Memcpy HtoD (Pageable -> Device)": 0.5, "Memcpy DtoD (Device -> Device)": 0.25,
            "void cudnn::bn_fw_inf_1C11_kernel_NHWC<float>": 1.0}


def rec(kernel_s, calls=4, kind="serve_stream"):
    return {"kind": kind, "profile": {"calls": calls, "kernel_s": kernel_s, "busy_s": 1.0}}


def test_sums_the_device_to_host_copies_over_the_frames():
    read = manifest.reader("serve.d2h_memcpy_ms")
    assert read(rec(KERNEL_S)) == pytest.approx(1e3 * 0.008 / 4)
    assert read(rec(KERNEL_S, calls=8)) == pytest.approx(1e3 * 0.008 / 8)


@pytest.mark.parametrize("record", [
    {}, {"kind": "serve_stream"}, {"kind": "serve_stream", "profile": None},
    rec({k: v for k, v in KERNEL_S.items() if not k.startswith("Memcpy DtoH")}),
    rec({}), rec(KERNEL_S, calls=0), rec(KERNEL_S, kind="train_steps")])
def test_none_without_a_copy_to_read(record):
    assert manifest.reader("serve.d2h_memcpy_ms")(record) is None
