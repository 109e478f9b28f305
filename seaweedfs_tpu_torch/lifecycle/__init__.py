"""Data-lifecycle plane: declarative per-collection rules (policy.py)
and the master-coordinated daemon that enforces them (daemon.py) —
cold volumes tier to a remote backend, TTL data actually expires, hot
tiered volumes promote back to local disk."""

from .daemon import LifecycleDaemon
from .policy import (Policy, PolicyError, Rule, load_rules,
                     parse_duration, parse_rules_text)

__all__ = ["LifecycleDaemon", "Policy", "PolicyError", "Rule",
           "load_rules", "parse_duration", "parse_rules_text"]
