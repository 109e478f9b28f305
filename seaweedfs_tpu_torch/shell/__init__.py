"""Admin shell: command registry + maintenance/EC lifecycle commands.

Reference: weed/shell/ — the `weed shell` REPL with its `command` interface
(shell/commands.go:35-42) and the ec.*/volume.* maintenance command suite.
Commands here drive the cluster purely through the master/volume-server
RPC surfaces, exactly as the reference shell drives gRPC.
"""

from .commands import COMMANDS, Command, run_command  # noqa: F401
from .env import CommandEnv, ShellError  # noqa: F401

# Importing the command modules registers them.
from . import command_ec  # noqa: F401,E402
from . import command_fs  # noqa: F401,E402
from . import command_volume  # noqa: F401,E402
from . import command_misc  # noqa: F401,E402
from . import command_trace  # noqa: F401,E402
from . import command_fault  # noqa: F401,E402
from . import command_cluster  # noqa: F401,E402
from . import command_profile  # noqa: F401,E402
from . import command_mirror  # noqa: F401,E402
from . import command_lifecycle  # noqa: F401,E402
from . import command_tenant  # noqa: F401,E402
