"""Pricing and cost accounting (paper Fig. 2/3).

Prices are per-instance-hour. The paper's case study uses Azure D8s_v3
(on-demand $0.38/hr, spot $0.076/hr — an 80% discount) and Azure Files NFS at
$16 per 100 GiB provisioned per month. We also ship a TPU-v5e-like sheet for
the framework's target hardware (public list prices, us-central, mid-2024:
~$1.20/chip-hr on-demand, ~$0.47 preemptible) plus size-comparable AWS/GCP
sheets (8 vCPU / 32 GiB; us-east list prices with typical spot discounts, and
EFS / Filestore standing in for the shared checkpoint volume) used by the
multi-cloud provider backends.
"""

from __future__ import annotations

from dataclasses import dataclass, field

GIB = 1024 ** 3
MONTH_S = 30 * 24 * 3600.0


@dataclass(frozen=True)
class PriceSheet:
    name: str
    ondemand_per_hr: float
    spot_per_hr: float
    storage_per_100gib_month: float = 16.0

    @property
    def spot_discount(self) -> float:
        return 1.0 - self.spot_per_hr / self.ondemand_per_hr


AZURE_D8S_V3 = PriceSheet("azure-d8s-v3", ondemand_per_hr=0.38, spot_per_hr=0.076)
TPU_V5E_CHIP = PriceSheet("tpu-v5e-chip", ondemand_per_hr=1.20, spot_per_hr=0.47)
AWS_M5_2XLARGE = PriceSheet("aws-m5-2xlarge", ondemand_per_hr=0.384,
                            spot_per_hr=0.134, storage_per_100gib_month=30.0)
GCP_N2_STANDARD_8 = PriceSheet("gcp-n2-standard-8", ondemand_per_hr=0.388,
                               spot_per_hr=0.097, storage_per_100gib_month=20.0)


@dataclass
class CostAccountant:
    """Integrates instance-seconds and provisioned storage into dollars."""

    prices: PriceSheet
    instance_seconds: dict[str, float] = field(default_factory=dict)  # kind -> s
    storage_gib_provisioned: float = 0.0
    storage_seconds: float = 0.0
    _storage_last_mark: float | None = None

    def record_instance(self, kind: str, seconds: float, count: int = 1) -> None:
        if kind not in ("spot", "ondemand"):
            raise ValueError(kind)
        self.instance_seconds[kind] = self.instance_seconds.get(kind, 0.0) + seconds * count

    def provision_storage(self, gib: float, now: float) -> None:
        self._flush_storage(now)
        self.storage_gib_provisioned = max(self.storage_gib_provisioned, gib)
        if self._storage_last_mark is None:
            self._storage_last_mark = now

    def _flush_storage(self, now: float) -> None:
        if self._storage_last_mark is not None:
            self.storage_seconds += (now - self._storage_last_mark) * self.storage_gib_provisioned
            self._storage_last_mark = now

    def compute_cost(self) -> dict[str, float]:
        spot_hr = self.instance_seconds.get("spot", 0.0) / 3600.0
        od_hr = self.instance_seconds.get("ondemand", 0.0) / 3600.0
        return {
            "spot_usd": spot_hr * self.prices.spot_per_hr,
            "ondemand_usd": od_hr * self.prices.ondemand_per_hr,
        }

    def storage_cost(self, now: float) -> float:
        self._flush_storage(now)
        gib_months = self.storage_seconds / MONTH_S
        return gib_months * (self.prices.storage_per_100gib_month / 100.0)

    def total_usd(self, now: float) -> float:
        c = self.compute_cost()
        return c["spot_usd"] + c["ondemand_usd"] + self.storage_cost(now)

    def summary(self, now: float) -> dict[str, float]:
        c = self.compute_cost()
        return {
            **c,
            "storage_usd": self.storage_cost(now),
            "total_usd": self.total_usd(now),
            "spot_hours": self.instance_seconds.get("spot", 0.0) / 3600.0,
            "ondemand_hours": self.instance_seconds.get("ondemand", 0.0) / 3600.0,
        }
