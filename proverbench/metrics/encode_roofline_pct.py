"""Layer: kernels (``csrc/planar.cu`` KB passes and KE mont_scalar).  The
encode's least time at the published multiply-add rate (``roofline.py``:
64 per clock per SM x 132 SMs x 1,980 MHz), for the work of every call of
the executor's encode entries in the traced window at its own shape, over
the device time of every kernel launched inside those calls (attributed by
the ranges the harness places around the entries, not by kernel names)."""

import roofline


def read(run):
    if run.trace is None or not run.trace.encode_device_s \
            or not run.encode_calls:
        return None
    return 100.0 * roofline.encode_least_s(run.encode_calls) \
        / run.trace.encode_device_s
