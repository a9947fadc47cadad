"""synth.abc_s: ``SynthesizedProgram.synthesis_seconds``, Stages A-C."""


def read(run):
    return run.synth_s
