"""``events_per_s``: the events of every window whose delta came back
inside the measured loop, all arrays together, over the loop's whole wall
time: how many arrays' worth of spikes one card keeps up with."""


def read(rec):
    return sum(d.n_events for d in rec.done) / (rec.t_close - rec.t_open)
