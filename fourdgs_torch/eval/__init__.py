from fourdgs_torch.eval.ate import align_horn, evaluate_ate  # noqa: F401
from fourdgs_torch.eval.rendering import eval_rendering  # noqa: F401
