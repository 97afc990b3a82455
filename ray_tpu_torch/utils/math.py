"""Integer math helpers used by the kernel wrappers."""


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)
