"""The benchmark's frozen yardstick: the work of a factorization counted
from its shapes, and the published peaks of the card it is held to."""
