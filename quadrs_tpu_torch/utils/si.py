"""SI-suffixed number parsing, matching the reference CLI's grammar.

Mirrors ``src/args.rs:335-390``: a trailing ``k`` / ``M`` / ``G`` multiplies
by 1e3 / 1e6 / 1e9; anything else parses plainly.  Booleans additionally
accept yes/y/no/n.
"""

from __future__ import annotations

_SUFFIXES = {"k": 1_000, "M": 1_000_000, "G": 1_000_000_000}


def _split_suffix(text: str) -> tuple[str, int]:
    if text and text[-1] in _SUFFIXES:
        return text[:-1], _SUFFIXES[text[-1]]
    return text, 1


def parse_si_int(text: str) -> int:
    """Parse a signed integer with optional SI suffix (``src/args.rs:354-362``)."""
    body, mul = _split_suffix(text)
    return _strict_int(body) * mul


def parse_si_uint(text: str) -> int:
    """Parse an unsigned integer with optional SI suffix (``src/args.rs:364-371``)."""
    body, mul = _split_suffix(text)
    value = _strict_int(body)
    if value < 0 or body.startswith(("-", "+")):
        # Rust's u64 parser rejects signs entirely.
        raise ValueError(f"invalid unsigned integer: {text!r}")
    return value * mul


def parse_si_float(text: str) -> float:
    """Parse a float with optional SI suffix (``src/args.rs:373-379``)."""
    body, mul = _split_suffix(text)
    # Rust's f64 parser rejects Python-isms like underscores / whitespace
    if not body or body.strip() != body or "_" in body:
        raise ValueError(f"invalid float: {body!r}")
    return float(body) * mul


def _strict_int(body: str) -> int:
    # Python's int() accepts underscores and surrounding whitespace; Rust's
    # parse::<i64>() does not.
    if not body or body.strip() != body or "_" in body:
        raise ValueError(f"invalid integer: {body!r}")
    return int(body)


def parse_plain_uint(text: str) -> int:
    """Plain unsigned integer, no SI suffix (Rust ``parse::<usize>()``)."""
    value = _strict_int(text)
    if value < 0 or text.startswith(("-", "+")):
        raise ValueError(f"invalid unsigned integer: {text!r}")
    return value


def parse_plain_float(text: str) -> float:
    """Plain float, no SI suffix (Rust ``parse::<f32>()`` strictness)."""
    if not text or text.strip() != text or "_" in text:
        raise ValueError(f"invalid float: {text!r}")
    return float(text)


def parse_bool(text: str) -> bool:
    """Parse a boolean (``src/args.rs:381-390``): true/false plus yes/y/no/n."""
    if text == "true":
        return True
    if text == "false":
        return False
    if text in ("yes", "y"):
        return True
    if text in ("no", "n"):
        return False
    raise ValueError(f"unacceptable boolean value: '{text}'")
