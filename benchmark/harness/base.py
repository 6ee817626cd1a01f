"""What every driver holds: the cell's configuration and traffic (with a
test's overrides at a smaller size), the seed, the device, the variant, the
cell's plain reference, and the count of failed calls; and `worst`, the
fold of the compared numbers."""

import math


class Driver:
    #: True where the driver's set-up runs inside the program's own call and
    #: the driver opens the window itself (`Window.open`) when set-up ends
    opens_window = False

    def __init__(self, cell, seed, device, variant=None, overrides=None):
        overrides = overrides or {}
        self.cfg = {**cell.config, **overrides.get("config", {})}
        self.traffic = {**cell.traffic, **overrides.get("traffic", {})}
        self.seed, self.device, self.variant = seed, device, variant
        self.ref = cell.reference_module
        self.failed = 0


def worst(*values) -> float:
    """The largest of the gaps `values`; infinite where any is not a
    number, so that a NaN on either side can never read as agreement."""
    values = [float(v) for v in values]
    if any(math.isnan(v) for v in values):
        return math.inf
    return max(values)
