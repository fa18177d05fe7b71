"""Set-up seconds: process start to the window's opening (imports, the
kernels' build where the checkout has none, the weights, the model, the
warm-up, and the mix's unmeasured ramp of traffic). Host clock."""


def read(run):
    return run.setup_s + run.ramp_s
