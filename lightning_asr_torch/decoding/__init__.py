from .device_beam import DeviceBeamSearchDecoder, beam_search_device
from .greedy import greedy_collapse_device, greedy_decode_to_strings

__all__ = [
    "DeviceBeamSearchDecoder",
    "beam_search_device",
    "greedy_collapse_device",
    "greedy_decode_to_strings",
]
