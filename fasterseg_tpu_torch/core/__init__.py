from .genotype import (
    PRIMITIVES,
    ArchParams,
    Genotype,
    decode_network,
    network_metas,
    path_to_downs,
    downs_to_path,
    betas_to_path,
    path_to_widths,
)
from .plan import CellSpec, NetworkPlan, build_plan, num_filters
from .config import (
    WIDTH_MULT_LIST,
    DataConfig,
    SearchConfig,
    TrainConfig,
    LatencyConfig,
    cityscapes_search_config,
    cityscapes_pretrain_config,
    cityscapes_teacher_config,
    cityscapes_student_config,
)
