"""Host-side crystallography for the port: unit cells, space groups, the
numpy DataSet, MTZ I/O, and the CrystFEL .stream (stream.py) and XDS
(xds.py) readers (numpy only; counterpart of careless_tpu/xtal/)."""
from .cell import UnitCell
from .dataset import DataSet, concat_datasets
from .mtz import read_mtz, write_mtz
from .symmetry import SpaceGroup
from .symop import Op, close_group

__all__ = [
    "UnitCell", "DataSet", "concat_datasets", "read_mtz", "write_mtz",
    "SpaceGroup", "Op", "close_group",
]
