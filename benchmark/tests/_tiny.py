"""Each cell at a size a CPU test run holds: the same files, smaller
meshes and batches.  The beam cells soften their void (Emin 1e-3): the
CPU takes the port's plain route, whose float32 CG does not reach the
configuration's residual at a contrast of 1e9 within its step limit."""

_BEAM = {"config": {"mesh": {"dims": [12, 4, 4], "hi": [6.0, 2.0, 2.0]},
                    "material": {"Emin": 1e-3}}}

TINY = {
    "beam1m_tet4.designs": _BEAM,
    "beam1m_tet4.loads": _BEAM,
    "box_sweep_c5.batch": {"config": {"mesh": {"dims": [8, 4, 2]}},
                           "traffic": {"densities": 2, "judged_lanes": 8}},
}
