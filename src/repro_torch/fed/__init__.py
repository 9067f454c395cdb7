from repro_torch.fed.api import (  # noqa: F401
    FedMethod, FLConfig, StateField, get_method, register_method,
    registered_methods, registered_stores, registered_trackers,
)
from repro_torch.fed.methods import MethodConfig, Task  # noqa: F401
from repro_torch.fed.sampling import registered_samplers  # noqa: F401
from repro_torch.fed.simulator import Simulator  # noqa: F401
