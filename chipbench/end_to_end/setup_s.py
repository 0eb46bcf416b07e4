"""``setup_s``: seconds from the process's start to the opening of the
measured loop: imports, the recordings made from the seed, the kernels'
libraries built or loaded, and each array's first windows mined."""


def read(rec):
    return rec.setup_s
