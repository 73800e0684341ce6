"""The multi-device layer: SPMD over ``torch.distributed``, one shard of the
``rows`` axis a rank (``mesh.py``), the pair-sharded dense assembly, the
marker-sharded PIC and the halo-exchange banded matvec (``sharded.py``),
and the distributed SPIKE banded solve (``spike.py``)."""
from . import mesh  # noqa: F401
