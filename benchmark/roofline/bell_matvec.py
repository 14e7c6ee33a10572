"""B4, the block-ELL SpMV (``ops/bell.bell_matvec`` ->
``csrc/bell_apply.cu`` ``csr_matvec_kernel`` over 3x3 blocks): the least
time of one launch, from the matrix it was handed.

A frozen copy of chip_smoke.py's block-ELL arithmetic (phase 8f's
``bell_bound``): bytes are the row pointers, each block's column index
and its values at their width (and the lo plane's, where there is one),
the vector read once and the output written once; operations are 18 a
block (a 3x3 block times a 3-vector into 3 sums), twice with a lo plane.

``Hook`` wraps ``topopteval_tpu_torch.fem.bell.bell_matvec``, the name
the block-ELL operators call, in this process only (the program's files
are not changed), from before set-up: it keeps the least seconds of every
call, and of the calls made while ``active`` (the traced requests) apart.
"""

from __future__ import annotations

from benchmark.roofline.peaks import least_seconds

#: the parts of B4's kernel name in a trace (B5 is the same template over
#: ``Weight<...>``)
KERNEL = ("csr_matvec_kernel", "Block<")
FLOPS_PER_BLOCK = 18


def launch_bytes(n_rows: int, nnz: int, val_bytes: int, lo_bytes: int,
                 n_cols: int, itemsize: int) -> int:
    return ((n_rows + 1) * 4 + nnz * 4 + val_bytes + lo_bytes
            + 3 * n_cols * itemsize + 3 * n_rows * itemsize)


def launch_seconds(u, A, vals_lo) -> float:
    item = u.element_size()
    lo = 0 if vals_lo is None else vals_lo.numel() * vals_lo.element_size()
    n_bytes = launch_bytes(A.n_rows, A.nnz,
                           A.vals.numel() * A.vals.element_size(), lo,
                           A.n_cols, item)
    flops = FLOPS_PER_BLOCK * A.nnz * (1 if vals_lo is None else 2)
    return least_seconds(n_bytes, flops, item)


class Hook:
    KERNEL = KERNEL

    def __init__(self, tt):
        from topopteval_tpu_torch.fem import bell
        self._mod = bell
        self._orig = bell.bell_matvec
        self.active = False
        self.launches = []          # calls while active
        self.calls = []             # every call since set-up began

        def wrapped(u, A, vals_lo=None):
            if u.device.type == "cuda" and A.n_rows:
                least = launch_seconds(u, A, vals_lo)
                self.calls.append(least)
                if self.active:
                    self.launches.append(least)
            return self._orig(u, A, vals_lo)

        bell.bell_matvec = wrapped

    def least_seconds(self, traced_launches: int) -> float:
        """The least seconds of the trace's ``traced_launches`` B4
        launches: the sum over the traced calls where every launch came
        through the binding; otherwise (launches replayed without a call,
        as from a CUDA graph) that many times the mean over every call
        since set-up, which holds while each iteration launches the same
        mix of matrices.  An error where the trace has B4 launches and the
        binding saw none: the bytes of those launches are unknown."""
        if not self.calls:
            raise RuntimeError(
                f"{traced_launches} B4 launches in the trace, none through "
                "fem.bell.bell_matvec: b4_roofline cannot count their bytes")
        if traced_launches == len(self.launches):
            return sum(self.launches)
        return traced_launches * sum(self.calls) / len(self.calls)

    def remove(self):
        self._mod.bell_matvec = self._orig
