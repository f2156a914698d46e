from fourdgs_torch.utils.config import ConfigDict  # noqa: F401
from fourdgs_torch.utils.draws import TorchDraws  # noqa: F401
from fourdgs_torch.utils.logging import Log  # noqa: F401
