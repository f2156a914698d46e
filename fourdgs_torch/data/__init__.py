from fourdgs_torch.data.base import BaseDataset, load_dataset  # noqa: F401
from fourdgs_torch.data.synthetic import SyntheticDataset  # noqa: F401
