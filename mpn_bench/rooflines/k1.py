"""The least work of one launch of K1, greedy NMS suppression over B images
of K score-sorted boxes: each box read once (16 bytes) with its validity
(1 byte), each keep flag written once (1 byte); the +1-pixel IoU of every
pair i < j (15 float operations: 4 each for the overlap's width and height,
2 clamps, the product, 2 for the union, the divide and the compare) and
each box's area once (5 operations).  The greedy scan's order is latency,
not work, and counts nothing."""

IOU_OPS = 15
AREA_OPS = 5


def work(b: int, k: int):
    """(float operations, bytes) of one launch at (B, K)."""
    pairs = b * k * (k - 1) // 2
    return pairs * IOU_OPS + b * k * AREA_OPS, b * k * (16 + 1 + 1)
