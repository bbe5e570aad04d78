from hyrise_tpu_torch.plan import lqp  # noqa: F401
from hyrise_tpu_torch.plan.translator import translate_lqp  # noqa: F401
from hyrise_tpu_torch.plan.optimizer import Optimizer  # noqa: F401
