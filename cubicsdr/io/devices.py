"""Device enumeration and capability metadata.

SDREnumerator/SDRDeviceInfo analog (ref: src/sdr/SDREnumerator.cpp:89-171
module loading + local/remote/manual enumeration; src/sdr/SDRDeviceInfo.h:
85-95 capability queries; rate list clamped to 25 entries,
ref: src/CubicSDRDefs.h:73). Backends:

  - 'synthetic' : always present (the fake-source device)
  - 'file'      : recorded captures registered as devices
  - 'soapy'     : real SoapySDR hardware IF the python module is installed
                  (optional — absent on most server images)
  - manual      : user-defined device strings (ref: SDREnumerator::setManuals)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

MAX_RATE_LIST = 25      # ref: src/CubicSDRDefs.h:73


@dataclass
class SDRDeviceInfo:
    device_id: str
    name: str
    driver: str
    available: bool = True
    remote: bool = False
    manual: bool = False
    sample_rates: list = field(default_factory=lambda: [
        250_000, 1_000_000, 2_000_000, 2_400_000, 2_500_000, 3_200_000,
        4_000_000, 5_000_000, 8_000_000, 10_000_000, 16_000_000,
        20_000_000])
    gains: dict = field(default_factory=lambda: {"TUNER": (0.0, 49.6)})
    antennas: list = field(default_factory=lambda: ["RX"])
    freq_range: tuple = (0.0, 6e9)

    def get_sample_rates(self) -> list:
        return sorted(self.sample_rates)[:MAX_RATE_LIST]

    def get_rate_near(self, rate: float) -> int:
        """Nearest supported rate (ref: SDRDeviceInfo::getSampleRateNear)."""
        return min(self.get_sample_rates(), key=lambda r: abs(r - rate))


class SDREnumerator:
    """Device discovery across backends + manual/remote registration."""

    def __init__(self):
        self.remotes: list[str] = []
        self.manuals: list[dict] = []

    def add_remote(self, address: str):
        if address not in self.remotes:
            self.remotes.append(address)

    def remove_remote(self, address: str):
        if address in self.remotes:
            self.remotes.remove(address)

    def set_manuals(self, manuals: list[dict]):
        self.manuals = list(manuals)

    def enumerate_devices(self) -> list[SDRDeviceInfo]:
        devs = [SDRDeviceInfo("synthetic=0", "Synthetic Signal Generator",
                              "synthetic")]
        try:  # optional real-hardware backend
            import SoapySDR  # type: ignore
            for i, kw in enumerate(SoapySDR.Device.enumerate()):
                devs.append(SDRDeviceInfo(
                    f"soapy={i}", dict(kw).get("label", f"soapy {i}"),
                    dict(kw).get("driver", "unknown")))
        except ImportError:
            pass
        for addr in self.remotes:
            devs.append(SDRDeviceInfo(f"remote={addr}", f"Remote {addr}",
                                      "remote", remote=True))
        for m in self.manuals:
            devs.append(SDRDeviceInfo(
                f"manual={m.get('driver', '?')}",
                m.get("label", "Manual Device"),
                m.get("driver", "manual"), manual=True))
        return devs
