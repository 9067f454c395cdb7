from repro_torch.data.dirichlet import dirichlet_partition  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    SPECS, DatasetSpec, federated_splits, make_image_dataset,
)
