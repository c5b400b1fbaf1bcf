"""Models of the port: the descriptor models (SSCD on a ResNet-50 trunk,
DINO ViT-S/16, the DnS L3-iMAC extractor), BatchNorm folding, and the
DnS students."""

from vsc2022_torch.models.dns import (  # noqa: F401
    L3_IMAC_DIM,
    NUM_REGIONS,
    REDUCED_DIM,
    CoarseStudentModule,
    DnSStudent,
    FineGrainedStudentModule,
    L3iMACExtractor,
    chamfer_similarity,
)
from vsc2022_torch.models.fold import fold_batchnorm, s2d_stem  # noqa: F401
from vsc2022_torch.models.resnet import ResNet50  # noqa: F401
from vsc2022_torch.models.sscd import SSCDModel  # noqa: F401
from vsc2022_torch.models.vit import DinoViT  # noqa: F401
