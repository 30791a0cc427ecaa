from llavamod_tpu_torch.utils.logging import build_logger, rank0_print
from llavamod_tpu_torch.utils.registry import Registry
from llavamod_tpu_torch.utils.misc import order_pick_k
