"""Config honesty for the port, after `tests/test_config_consumed.py`: every field of the
port's `core/config.py` dataclasses is read (as `.name`) somewhere in the port's package
outside `core/config.py`. No field is excepted: `ParallelConfig.backend_solver` and
`mesh_devices` are read by the mesh pipeline."""

import dataclasses
import pathlib
import re

import lidar_graph_slam_tpu_torch.core.config as config_mod

PKG_ROOT = pathlib.Path(config_mod.__file__).resolve().parents[1]


def _all_config_fields():
    fields = set()
    for obj in vars(config_mod).values():
        if dataclasses.is_dataclass(obj) and isinstance(obj, type):
            fields.update(f.name for f in dataclasses.fields(obj))
    return fields


def test_every_config_field_is_consumed():
    config_path = pathlib.Path(config_mod.__file__).resolve()
    blob = "\n".join(py.read_text() for py in PKG_ROOT.rglob("*.py")
                     if py.resolve() != config_path)
    unconsumed = sorted(name for name in _all_config_fields()
                        if not re.search(r"\." + re.escape(name) + r"\b", blob))
    assert not unconsumed, f"config fields declared but never read outside config.py: {unconsumed}"


def test_the_port_imports_neither_jax_nor_the_reference():
    """No module of the port (its `parallel/` package included) imports JAX or the JAX
    package: the card's machine has neither."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax|lidar_graph_slam_tpu)(\s|\.|$)", re.M)
    offenders = [str(py.relative_to(PKG_ROOT)) for py in PKG_ROOT.rglob("*.py")
                 if bad.search(py.read_text())]
    assert not offenders, offenders
    assert {"distributed.py", "schur.py", "multi_sequence.py", "multihost.py"} <= {
        p.name for p in (PKG_ROOT / "parallel").glob("*.py")}
