"""TOML config loading — the reference's viper setup (weed/util/config.go,
weed/command/scaffold.go:12-58).

Search order for `<name>.toml`: `./`, `~/.seaweedfs/`, `/etc/seaweedfs/`
(util/config.go LoadConfiguration).  `WEED_<SECTION>_<KEY>=val` environment
variables override file values, matching viper's `WEED_` AutomaticEnv with
`.`->`_` replacement.
"""

from __future__ import annotations

import os
from typing import Any

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.10: stdlib tomllib is 3.11+
    try:
        import tomli as tomllib  # type: ignore[no-redef]
    except ModuleNotFoundError:
        # No TOML parser available.  The common case — no config file
        # on disk — must still work (every CLI command loads
        # security.toml at startup and an absent file is an empty
        # config); only actually PARSING a file requires the parser.
        tomllib = None  # type: ignore[assignment]

SEARCH_PATHS = [".", os.path.expanduser("~/.seaweedfs"), "/etc/seaweedfs"]


class Configuration:
    """Flattened dotted-key view over a parsed TOML tree + env overrides."""

    def __init__(self, tree: dict[str, Any] | None = None):
        self._flat: dict[str, Any] = {}
        if tree:
            self._flatten("", tree)

    def _flatten(self, prefix: str, tree: dict[str, Any]) -> None:
        for k, val in tree.items():
            key = f"{prefix}{k}"
            if isinstance(val, dict):
                self._flatten(key + ".", val)
            else:
                self._flat[key.lower()] = val

    def _env_override(self, key: str) -> str | None:
        env_key = "WEED_" + key.upper().replace(".", "_").replace("-", "_")
        return os.environ.get(env_key)

    def get(self, key: str, default: Any = None) -> Any:
        env = self._env_override(key)
        if env is not None:
            return env
        return self._flat.get(key.lower(), default)

    def get_bool(self, key: str, default: bool = False) -> bool:
        val = self.get(key, default)
        if isinstance(val, str):
            return val.lower() in ("1", "true", "yes", "on")
        return bool(val)

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self.get(key, default))

    def get_string(self, key: str, default: str = "") -> str:
        return str(self.get(key, default))

    def sub(self, prefix: str) -> dict[str, Any]:
        """All keys under `prefix.` with the prefix stripped."""
        p = prefix.lower() + "."
        return {k[len(p):]: v for k, v in self._flat.items()
                if k.startswith(p)}


def load_configuration(name: str, required: bool = False,
                       search_paths: list[str] | None = None
                       ) -> Configuration:
    """Find and parse `<name>.toml` along the search path."""
    for d in search_paths or SEARCH_PATHS:
        path = os.path.join(d, name + ".toml")
        if os.path.isfile(path):
            if tomllib is None:
                raise RuntimeError(
                    f"found {path} but no TOML parser is available "
                    "(stdlib tomllib needs Python 3.11+; or pip "
                    "install tomli)")
            with open(path, "rb") as f:
                return Configuration(tomllib.load(f))
    if required:
        raise FileNotFoundError(
            f"{name}.toml not found in {search_paths or SEARCH_PATHS}; "
            f"run `weed scaffold -config={name}` to generate a template")
    return Configuration()
