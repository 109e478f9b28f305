"""Fault-injection subsystem (see registry.py for the design).

Public surface:

- `registry.ARMED` / `registry.hit(point, **ctx)`: the hot-path pair —
  call sites guard `hit` behind `if ARMED:` so a disarmed process pays
  one dict truthiness check and nothing else.
- `arm(point, spec)` / `disarm(point)` / `disarm_all()`: programmatic
  control (tests, shell, /debug/faults).
- `POINTS`: the static fault-point catalog.
- `setup_fault_routes(server)`: mounts /debug/faults when enabled.
- `FaultInjected` / `DropConnection`: the injected failure types.
"""

from .registry import (ARMED, POINTS, DropConnection,  # noqa: F401
                       FaultInjected, FaultSpec, arm, arm_from_env,
                       disarm, disarm_all, hit, snapshot)
from .routes import (faults_route_enabled,  # noqa: F401
                     setup_fault_routes)
