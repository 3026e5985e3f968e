from quadrs_tpu_torch.utils.si import parse_bool, parse_si_float, parse_si_int, parse_si_uint
from quadrs_tpu_torch.utils.sniff import guess_details, guess_format_from_name

__all__ = [
    "parse_si_int",
    "parse_si_uint",
    "parse_si_float",
    "parse_bool",
    "guess_details",
    "guess_format_from_name",
]
