"""Integer math helpers used by the kernel wrappers."""


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up_to_multiple(x: int, m: int) -> int:
    """Round ``x`` up to the nearest multiple of ``m``."""
    return cdiv(x, m) * m
