"""The FedBack round engine of the port (``repro/core``)."""
from repro_torch.utils.ragged import (  # noqa: F401  (ragged shards)
    RaggedSpec,
    make_ragged_spec,
    pool_data,
    pool_rows,
)
from .baselines import (  # noqa: F401
    ScaffoldState,
    baseline_config,
    init_scaffold,
    make_scaffold_round,
)
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
    clamp_target_rate,
    controller_step,
    delta_bounds,
    demand_load_step,
    feasible_rate,
    init_controller,
    realized_rate,
    tracking_error_bounds,
)
from .fedback import (  # noqa: F401
    ADMM_FAMILY,
    AVG_FAMILY,
    FLConfig,
    events_to_accuracy,
    init_state,
    make_eval_fn,
    make_round_fn,
    run_evaluated,
    run_rounds,
)
from .hoststate import (  # noqa: F401
    host_state_from_tree,
    host_state_to_device,
    init_host_state,
    make_host_round_fn,
)
from .selection import (  # noqa: F401
    BernoulliSelection,
    FedBackSelection,
    FullSelection,
    RandomSelection,
    RoundRobinSelection,
    make_selection,
    subset_size,
)
from .schedule import (  # noqa: F401
    TRACE_KINDS,
    ServeReport,
    TraceConfig,
    make_trace,
    run_trace,
    serve,
    sync_trace,
)
from .trigger import evaluate_trigger, trigger_distances, \
    trigger_events  # noqa: F401
from .state import DeferQueue, FLState, HostState, InFlight, \
    RoundMetrics, delay_schedule, init_inflight  # noqa: F401
