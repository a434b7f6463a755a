"""Multi-cloud provider backends. See base.CloudProvider for the contract."""

from __future__ import annotations

from .base import (CloudProvider, PlatformEvent, PreemptNotice, PREEMPT_KIND,
                   REBALANCE_KIND)
from .azure import AzureProvider
from .aws import AwsProvider, SimulatedIMDS
from .gcp import GcpProvider, SimulatedGceMetadata

PROVIDERS: dict[str, type[CloudProvider]] = {
    "azure": AzureProvider,
    "aws": AwsProvider,
    "gcp": GcpProvider,
}


def get_provider(name_or_provider) -> CloudProvider:
    """Resolve a provider name (or pass a CloudProvider through)."""
    if isinstance(name_or_provider, CloudProvider):
        return name_or_provider
    try:
        return PROVIDERS[str(name_or_provider).lower()]()
    except KeyError:
        raise ValueError(
            f"unknown cloud provider {name_or_provider!r}; "
            f"known: {sorted(PROVIDERS)}") from None


__all__ = [
    "AwsProvider", "AzureProvider", "CloudProvider", "GcpProvider",
    "PREEMPT_KIND", "PROVIDERS", "PlatformEvent", "PreemptNotice",
    "REBALANCE_KIND", "SimulatedGceMetadata", "SimulatedIMDS", "get_provider",
]
