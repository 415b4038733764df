"""The FedBack round engine of the port (``repro/core``)."""
from .compact import (  # noqa: F401
    CompactPlan,
    adaptive_limit,
    capacity_bounds,
    capacity_for,
    compact_plan,
    init_queue,
    queue_update,
)
from .controller import (  # noqa: F401
    ControllerConfig,
    ControllerState,
    controller_step,
    demand_load_step,
    init_controller,
)
from .fedback import (  # noqa: F401
    FLConfig,
    init_state,
    make_eval_fn,
    make_round_fn,
    run_rounds,
)
from .selection import (  # noqa: F401
    FedBackSelection,
    FullSelection,
    make_selection,
)
from .state import DeferQueue, FLState, RoundMetrics  # noqa: F401
