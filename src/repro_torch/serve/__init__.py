"""repro_torch.serve — the FL round service (`src/repro/serve/`,
DESIGN.md §12).

A `Coordinator` drives the simulator one round at a time from a
`ClientQueue` of simulated check-ins, with a registered `AdmissionPolicy`
sizing each cohort and a deadline policy cutting stragglers, all folded
into the Horvitz-Thompson weights through the "external" sampler and
fault tables, so Eq. 10-12 stays unbiased with no estimator change.
"""
from repro_torch.serve.admission import (  # noqa: F401
    AdmissionPolicy, get_policy, register_policy, registered_policies,
    resolve_opts,
)
from repro_torch.serve.coordinator import (  # noqa: F401
    Coordinator, make_serve_config,
)
from repro_torch.serve.queue import ClientQueue  # noqa: F401
