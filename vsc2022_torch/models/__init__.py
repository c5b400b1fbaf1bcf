"""Models of the port: the DnS students (``models/dns.py``)."""

from vsc2022_torch.models.dns import (  # noqa: F401
    L3_IMAC_DIM,
    NUM_REGIONS,
    REDUCED_DIM,
    CoarseStudentModule,
    DnSStudent,
    FineGrainedStudentModule,
    chamfer_similarity,
)
