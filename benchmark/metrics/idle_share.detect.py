"""Share of the traced slice's wall time with no kernel, copy or set on
the card (the union of the device intervals), detect cells."""
UNIT = '%'


def read(summary):
    if summary['entry'] != 'detect':
        return None
    return 100.0 * (1.0 - summary['busy_s'] / summary['window_s'])
