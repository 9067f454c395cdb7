from repro_torch.fed.aggregators import (  # noqa: F401
    Aggregator, get_aggregator, register_aggregator, registered_aggregators,
)
from repro_torch.fed.api import (  # noqa: F401
    FedMethod, FLConfig, MethodCtx, RoundCtx, StateField, get_method,
    register_method, registered_methods, registered_trackers,
)
from repro_torch.fed.faults import (  # noqa: F401
    FaultModel, get_fault, register_fault, registered_faults,
)
from repro_torch.fed.methods import ClientOut, MethodConfig, Task  # noqa: F401
from repro_torch.fed.sampling import (  # noqa: F401
    CohortSampler, get_sampler, register_sampler, registered_samplers,
)
from repro_torch.fed.simulator import Draws, Simulator  # noqa: F401
from repro_torch.fed.store import (  # noqa: F401
    StateStore, get_store, register_store, registered_stores,
)
