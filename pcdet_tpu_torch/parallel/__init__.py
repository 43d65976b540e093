"""Data-parallel training across processes (`ddp`), the counterpart of
`pcdet_tpu.parallel`."""
from . import ddp  # noqa: F401
