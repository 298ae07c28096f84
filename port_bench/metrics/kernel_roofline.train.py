"""The hand kernels' share of their roofline in a traced train run: over
the profiled pass after the window, each kernel's launches times its
mean bound per launch (port_bench/roofline.py at the launch's shapes, B3
and B4 on the pairs the frozen plain compositor counts on the same rows),
taken in an unprofiled pass of as many steps right after it, over its
CUDA kernels' device time in the trace."""

UNIT = "%"
DRIVER = "train"


def read(run):
    if run.data.get("driver") != DRIVER:
        return None
    from port_bench.bounds import roofline_share
    return roofline_share(run.data.get("kernel_launches") or {},
                          run.data.get("kernel_bound_s") or {},
                          (run.data.get("trace") or {}).get("kernel_s") or {})
