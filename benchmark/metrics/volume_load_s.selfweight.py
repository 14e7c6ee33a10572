"""volume_load_s.selfweight: the program's ``volume_force`` span (the
seconds of one ``apply_variable_density_volume_force`` call: the cell
quadrature on the device and the nodal sum on the host, as
``Problem.load_timings`` keeps them), mean over the window's requests.
None where the program keeps no such timings."""

from benchmark.metrics._read import mean

UNIT = "s"
KEY = "volume_force"


def read(run):
    return mean(r["load_timings"][KEY] for r in run.records
                if KEY in r.get("load_timings", {}))
