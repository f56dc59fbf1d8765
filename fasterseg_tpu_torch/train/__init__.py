"""Teacher/student training: losses, the SGD step, the session driver."""

from .loss import (
    cross_entropy,
    ohem_cross_entropy,
    kl_distillation,
    ohem_ce_topk,
    focal_loss,
    soft_cross_entropy,
    CITYSCAPES_CLASS_WEIGHTS,
)
from .loop import (
    TrainState,
    make_optimizer,
    learning_rate,
    set_learning_rate,
    train_step,
    make_eval_step,
)
from .driver import (
    TrainSession,
    run_train,
    build_model_from_arch,
    load_arch_any,
    write_test_predictions,
)
