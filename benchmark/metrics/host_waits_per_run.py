"""The host's waits on the device in one entry call: its ``wait.*`` spans
(the neurotransmitter gate, the uniform check, the dopamine, the closed
loop's pull), median over the entry calls of the port's span record
(`snnbench.spans`)."""

from snnbench import spans


def read(ctx):
    counts = [sum(s.name.startswith("wait.") for s in calls)
              for _, calls in spans.entry_calls(spans.record())]
    return spans.median(counts)
