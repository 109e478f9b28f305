"""cluster.profile — one flamegraph for the whole cluster, plus diffs.

Fans out to every reachable server's `/debug/pprof/profile` (mounted
with SEAWEEDFS_TPU_PPROF=1), pulls collapsed stacks — instantly from
each node's always-on ring (`?window=N`) or via a live sample
(`-seconds S`) — and merges them into ONE collapsed-stack corpus with
each stack rooted at a `node:<host:port>` frame, so a single
flamegraph shows the cluster's time split first by node, then by code.

`-diff baseline.collapsed` compares the live merge against a saved
baseline (node frames stripped, counts normalized to per-mille of
total samples) and ranks the biggest stack-share movements — the
gating artifact for hot-path refactors: profile before, land the
change, profile after, and the diff names exactly which stacks paid.

The port's copy of `seaweedfs_tpu/shell/command_profile.py`.
"""

from __future__ import annotations

from collections import Counter

from ..cluster import rpc
from .commands import Command, register
from .env import CommandEnv, ShellError

NODE_FRAME_PREFIX = "node:"


def parse_collapsed(text: str) -> Counter:
    """`frame;frame;... count` lines -> Counter keyed by the stack
    string.  Unparseable lines are skipped (profiles are operator
    artifacts, not a wire format)."""
    out: Counter = Counter()
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        if not stack or not count.isdigit():
            continue
        out[stack] += int(count)
    return out


def strip_node_frames(counts: Counter) -> Counter:
    """Drop the leading `node:<addr>` frame so profiles from different
    clusters/ports compare stack-for-stack in -diff."""
    out: Counter = Counter()
    for stack, n in counts.items():
        frames = stack.split(";")
        if frames and frames[0].startswith(NODE_FRAME_PREFIX):
            frames = frames[1:]
        if frames:
            out[";".join(frames)] += n
    return out


def fetch_node_profile(url: str, seconds: float | None,
                       window: int | None,
                       timeout: float = 45.0) -> Counter | None:
    """One node's collapsed stacks, each prefixed with its node frame;
    None when the node has no pprof surface (env off / unreachable)."""
    if seconds is not None:
        qs = f"?format=collapsed&seconds={seconds:g}"
    else:
        qs = f"?format=collapsed&window={window or 5}"
    try:
        raw = rpc.call(f"{url}/debug/pprof/profile{qs}",
                       timeout=timeout)
    except Exception:  # noqa: BLE001 — node gone or pprof off
        return None
    if isinstance(raw, dict):  # error doc from a JSON answer
        return None
    node = url.split("://", 1)[-1]
    counts: Counter = Counter()
    for stack, n in parse_collapsed(
            raw.decode("utf-8", "replace")).items():
        counts[f"{NODE_FRAME_PREFIX}{node};{stack}"] += n
    return counts


def merge_cluster_profile(urls: list[str], seconds: float | None = None,
                          window: int | None = None) -> tuple[Counter,
                                                              list[str]]:
    """Fan out + merge; returns (merged counts, nodes that answered).
    Live samples (`seconds`) run CONCURRENTLY so a 10s cluster profile
    costs 10s, not 10s x nodes — and every node samples the same
    interval of cluster time."""
    merged: Counter = Counter()
    nodes: list[str] = []
    if seconds is None:
        for url in urls:
            c = fetch_node_profile(url, None, window)
            if c is not None:
                merged.update(c)
                nodes.append(url)
        return merged, nodes
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(len(urls), 1)) as pool:
        futs = {pool.submit(fetch_node_profile, url, seconds, None):
                url for url in urls}
        for fut in concurrent.futures.as_completed(futs):
            c = fut.result()
            if c is not None:
                merged.update(c)
                nodes.append(futs[fut])
    return merged, nodes


def diff_profiles(baseline: Counter, current: Counter,
                  top: int = 20) -> list[dict]:
    """Rank stacks by |share delta| (per-mille of total samples) —
    share, not raw counts, so a longer/denser profile doesn't read as
    'everything got slower'."""
    base_total = sum(baseline.values()) or 1
    cur_total = sum(current.values()) or 1
    deltas = []
    for stack in set(baseline) | set(current):
        b = baseline.get(stack, 0) / base_total
        c = current.get(stack, 0) / cur_total
        if b == c:
            continue
        deltas.append({"stack": stack,
                       "baseline_share": b, "current_share": c,
                       "delta_share": c - b})
    deltas.sort(key=lambda d: -abs(d["delta_share"]))
    return deltas[:top]


@register
class ClusterProfile(Command):
    name = "cluster.profile"
    help = ("cluster.profile [-seconds N | -window N] [-node "
            "host:port] [-o out.collapsed] [-diff baseline.collapsed] "
            "[-top N] — merge every node's /debug/pprof stacks into "
            "one cluster flamegraph input (stacks rooted at "
            "node:<addr>).  Default: instant, from each node's "
            "always-on ring (last 5 windows); -seconds takes a live "
            "concurrent sample.  -o writes collapsed stacks for "
            "flamegraph.pl/speedscope; -diff ranks stack-share "
            "deltas vs a saved baseline (the refactor gate)")

    def do(self, args: list[str], env: CommandEnv) -> str:
        flags, _rest = self.parse_flags(args)
        seconds = window = None
        if flags.get("seconds"):
            try:
                seconds = min(max(float(flags["seconds"]), 0.1), 30.0)
            except ValueError:
                raise ShellError(
                    f"-seconds {flags['seconds']!r} is not a number") \
                    from None
        elif flags.get("window"):
            try:
                window = max(1, int(flags["window"]))
            except ValueError:
                raise ShellError(
                    f"-window {flags['window']!r} is not a number") \
                    from None
        try:
            top = int(flags.get("top", "20"))
        except ValueError:
            raise ShellError(
                f"-top {flags['top']!r} is not a number") from None
        if flags.get("node"):
            node = flags["node"]
            urls = [node if "://" in node else f"http://{node}"]
        else:
            urls = env.debug_servers({})
        merged, nodes = merge_cluster_profile(urls, seconds, window)
        if not nodes:
            raise ShellError(
                "no /debug/pprof/profile endpoint reachable — start "
                "servers with SEAWEEDFS_TPU_PPROF=1")
        total = sum(merged.values())
        lines = [f"{len(nodes)} node(s), {total} samples "
                 + (f"(live {seconds:g}s sample)" if seconds is not None
                    else f"(ring, last {window or 5} windows)")]
        if flags.get("o"):
            with open(flags["o"], "w") as f:
                for stack, n in merged.most_common():
                    f.write(f"{stack} {n}\n")
            lines.append(f"wrote {len(merged)} collapsed stacks to "
                         f"{flags['o']} (flamegraph.pl / speedscope "
                         f"input)")
        if flags.get("diff"):
            try:
                with open(flags["diff"]) as f:
                    baseline = parse_collapsed(f.read())
            except OSError as e:
                raise ShellError(
                    f"cannot read baseline {flags['diff']}: {e}") \
                    from None
            rows = diff_profiles(strip_node_frames(baseline),
                                 strip_node_frames(merged), top)
            lines.append("")
            lines.append(f"{'DELTA':>8}  {'BASE':>6}  {'NOW':>6}  "
                         "STACK (leaf last; shares in per-mille of "
                         "samples)")
            for d in rows:
                stack = d["stack"]
                if len(stack) > 110:
                    stack = "..." + stack[-107:]
                lines.append(
                    f"{1000 * d['delta_share']:+8.1f}  "
                    f"{1000 * d['baseline_share']:6.1f}  "
                    f"{1000 * d['current_share']:6.1f}  {stack}")
            if not rows:
                lines.append("no stack-share movement vs baseline")
            return "\n".join(lines)
        lines.append("")
        lines.append(f"{'SAMPLES':>8}  {'SHARE':>6}  STACK (leaf last)")
        for stack, n in merged.most_common(top):
            s = stack if len(stack) <= 110 else "..." + stack[-107:]
            lines.append(f"{n:8d}  {100.0 * n / total:5.1f}%  {s}")
        return "\n".join(lines)
