"""Host seconds of the training layout (Inputs.sorted_by_refl or
sorted_by_harmonic) and its gather plans (with_plans) in set-up."""


def read(run):
    return run.times["layout_s"] + run.times["plans_s"]
