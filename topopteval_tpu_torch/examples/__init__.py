"""The four workflow examples of the JAX package (examples/*.py), as
modules of the port: ``python -m topopteval_tpu_torch.examples.<name>
[--device cpu] [--out-dir DIR]``.  Each ``main(argv)`` returns its numbers
as a dict, so that tests and chip_smoke.py can check them."""

import argparse
import os

#: the repository's bundled meshes
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")


def parser(prog: str, description: str, mesh: str = None
           ) -> argparse.ArgumentParser:
    """The examples' common arguments: ``--device`` (default cuda),
    ``--out-dir`` for exported files, and a mesh path where the example
    reads one (default: the bundled fixture ``mesh``)."""
    ap = argparse.ArgumentParser(
        prog=f"python -m topopteval_tpu_torch.examples.{prog}",
        description=description)
    if mesh is not None:
        ap.add_argument("mesh", nargs="?", default=os.path.join(DATA, mesh))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=".")
    return ap
