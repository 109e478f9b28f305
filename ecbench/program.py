"""What the benchmark reads of the program besides its entry points:
its counters (the EC stage histograms of stats/metrics, as exposed to
Prometheus) and its kernels' names in a device trace."""

from __future__ import annotations

# A substring of K2's kernels' names in a trace (csrc/rs_bitmatrix_crc.cu).
K2_KERNEL = "rs_crc_"


def counters() -> dict[str, float]:
    """Every series of the EC stage histograms and byte counters, keyed
    by its exposition name and labels."""
    from seaweedfs_tpu_torch.stats import metrics
    out: dict[str, float] = {}
    for metric in (metrics.ec_stage_seconds, metrics.ec_stage_bytes):
        for line in metric.expose():
            if not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                out[key] = float(value)
    return out


def stage_seconds(stage: str) -> str:
    return f'SeaweedFS_ec_stage_seconds_sum{{stage="{stage}"}}'


def stage_bytes(stage: str) -> str:
    return f'SeaweedFS_ec_stage_bytes_total{{stage="{stage}"}}'
