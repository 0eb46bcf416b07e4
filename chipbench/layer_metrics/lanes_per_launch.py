"""``lanes_per_launch``: counters advanced per counting-kernel launch
inside the measured loop, from the program's kernel tally: a fused (K6)
launch advances its lanes, any other launch one counter."""


def read(rec):
    launches = sum(rec.launches.values())
    if not launches:
        return None
    lanes = sum(rec.lanes.get(k, n) for k, n in rec.launches.items())
    return lanes / launches
