"""Admin shell: command registry + maintenance/EC lifecycle commands.

Reference: weed/shell/ — the `weed shell` REPL with its `command` interface
(shell/commands.go:35-42) and the ec.*/volume.* maintenance command suite.
Commands here drive the cluster purely through the master/volume-server
RPC surfaces, exactly as the reference shell drives gRPC.

The port has the EC, volume and lock/collection/cluster commands; the
fs.*, trace, fault, cluster, profile, mirror, lifecycle and tenant
command modules wait for ROADMAP queue 1 slices 8c and 11.
"""

from .commands import COMMANDS, Command, run_command  # noqa: F401
from .env import CommandEnv, ShellError  # noqa: F401

# Importing the command modules registers them.
from . import command_ec  # noqa: F401,E402
from . import command_volume  # noqa: F401,E402
from . import command_misc  # noqa: F401,E402
