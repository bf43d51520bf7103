"""Morris-Lecar static-input run (the reference's
`backend/examples/morris_lecar/main.rs`): a single neuron driven by a
constant 100 uA/cm^2 current for 10k steps; the voltage trace is scanned
on device and summarized (the reference writes it to
`morris_lecar_static_input.csv` — pass ``csv_path`` to do the same).
PyTorch counterpart of ``examples/morris_lecar.py``, on ``device``
(``"cuda"`` by default): the JAX script's scan over the model's step is a
loop of steps on the device, the trace stacked once at the end.

Run: python -m spiking_neural_networks_tpu_torch.examples.morris_lecar
[--device cpu]"""

import torch

import spiking_neural_networks_tpu_torch as snn
from . import device_main


def main(iterations=10000, csv_path=None, device="cuda"):
    model = snn.MorrisLecar()
    state = model.init_state(1, device=device)
    current = torch.tensor([100.0], dtype=torch.float32, device=device)

    def step(s):
        s, spikes = model.step(s, current)
        return s, s["v"][0]

    voltages = []
    for _ in range(iterations):
        state, y = step(state)
        voltages.append(y)
    v = torch.stack(voltages).cpu().numpy()

    # oscillation summary: count upward zero-crossings of the limit cycle
    mid = 0.5 * (v.min() + v.max())
    crossings = int(((v[:-1] < mid) & (v[1:] >= mid)).sum())
    print(f"Morris-Lecar, I={float(current[0]):.0f}: V in "
          f"[{v.min():.2f}, {v.max():.2f}] mV over {iterations} steps, "
          f"{crossings} oscillations")

    if csv_path is not None:
        with open(csv_path, "w") as f:
            f.write("voltages\n")
            f.writelines(f"{x}\n" for x in v)
    return v


def cli(argv=None):
    """The command line: `main` on ``--device``."""
    return device_main(main, argv)


if __name__ == "__main__":
    cli()
