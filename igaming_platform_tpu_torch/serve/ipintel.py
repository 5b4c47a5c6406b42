"""IP intelligence — VPN/proxy/Tor classification for the risk gate.

Implements the IPIntelligence seam of the reference scoring engine
(engine.go:158-171): given an IP, return country/ISP plus anonymisation
flags that feed features 19-21 and rule 5. The reference treats this as an
external service; this in-process implementation classifies against
configurable CIDR range lists (loadable from JSON) with an LRU'd lookup,
and is swappable for a real provider behind the same `analyze` contract.
"""

from __future__ import annotations

import ipaddress
import json
import threading
from dataclasses import dataclass, field


@dataclass
class IPInfo:
    """Mirror of scoring.IPInfo (engine.go:163-171)."""

    country: str = ""
    city: str = ""
    isp: str = ""
    is_vpn: bool = False
    is_proxy: bool = False
    is_tor: bool = False
    risk_score: int = 0


@dataclass
class IPRanges:
    vpn: list[str] = field(default_factory=list)
    proxy: list[str] = field(default_factory=list)
    tor: list[str] = field(default_factory=list)
    country_ranges: dict[str, list[str]] = field(default_factory=dict)


class CIDRIPIntelligence:
    def __init__(self, ranges: IPRanges | None = None, cache_size: int = 65536):
        ranges = ranges or IPRanges()
        self._vpn = [ipaddress.ip_network(c) for c in ranges.vpn]
        self._proxy = [ipaddress.ip_network(c) for c in ranges.proxy]
        self._tor = [ipaddress.ip_network(c) for c in ranges.tor]
        self._countries = {
            country: [ipaddress.ip_network(c) for c in cidrs]
            for country, cidrs in ranges.country_ranges.items()
        }
        self._cache: dict[str, IPInfo] = {}
        self._cache_size = cache_size
        self._lock = threading.Lock()

    @classmethod
    def from_json(cls, path: str) -> "CIDRIPIntelligence":
        with open(path) as f:
            raw = json.load(f)
        return cls(IPRanges(
            vpn=raw.get("vpn", []),
            proxy=raw.get("proxy", []),
            tor=raw.get("tor", []),
            country_ranges=raw.get("country_ranges", {}),
        ))

    def analyze(self, ip: str) -> IPInfo:
        if not ip:
            return IPInfo()
        with self._lock:
            cached = self._cache.get(ip)
        if cached is not None:
            return cached

        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return IPInfo()

        info = IPInfo(
            is_vpn=any(addr in net for net in self._vpn),
            is_proxy=any(addr in net for net in self._proxy),
            is_tor=any(addr in net for net in self._tor),
        )
        for country, nets in self._countries.items():
            if any(addr in net for net in nets):
                info.country = country
                break
        info.risk_score = (
            (25 if info.is_tor else 0) + (15 if info.is_vpn else 0) + (10 if info.is_proxy else 0)
        )

        with self._lock:
            if len(self._cache) >= self._cache_size:
                self._cache.clear()
            self._cache[ip] = info
        return info

    def flags(self, ip: str) -> tuple[int, int, int]:
        """(vpn, proxy, tor) ints for ScoreRequest.ip_flags."""
        info = self.analyze(ip)
        return (int(info.is_vpn), int(info.is_proxy), int(info.is_tor))
