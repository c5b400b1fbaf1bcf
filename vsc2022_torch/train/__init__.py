"""Model training (counterpart of ``vsc2022_tpu/train``): SSCD-style
self-supervised fine-tuning and DnS student distillation, on the card
unless the caller asks for the CPU. The two-view augmentation is in
``vsc2022_torch.train.augment``, the CLI in ``vsc2022_torch.train.cli``."""

from vsc2022_torch.train.sscd_train import (  # noqa: F401
    TrainState,
    create_train_state,
    make_train_step,
    sscd_loss,
)

from vsc2022_torch.train.dns_distill import (  # noqa: F401
    DistillState,
    build_student_module,
    create_distill_state,
    make_distill_step,
    student_pair_similarity,
)
