"""b4_roofline.loads: the least time of the traced requests' B4 launches
(``ops/bell`` -> ``csrc/bell_apply.cu`` ``csr_matvec_kernel`` over 3x3
blocks), each from the matrix it was handed (roofline/bell_matvec.py),
over their device time in the trace, in percent.  None where the trace
holds no B4 launch."""

UNIT = "%"


def read(run):
    hook = run.hooks.get("bell_matvec")
    if hook is None or run.trace is None:
        return None
    n, secs = run.trace.seconds_matching(*hook.KERNEL)
    if n == 0 or secs <= 0:
        return None
    return 100.0 * hook.least_seconds(n) / secs
