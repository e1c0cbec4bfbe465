"""Closed loop: ``clients`` each keep one request in flight, sending the
next on its reply.  ``requests_per_client_per_s`` sizes the payloads made
before the window (a client that uses its list up starts it again)."""
import math

import numpy as np

LOOP = "closed"


def count(traffic: dict, seconds: float) -> int:
    per_client = max(1, math.ceil(traffic["requests_per_client_per_s"] * seconds))
    return traffic["clients"] * per_client


def arrivals(traffic: dict, n: int, permute):
    return np.zeros(n), np.repeat(np.arange(traffic["clients"]), n // traffic["clients"])
