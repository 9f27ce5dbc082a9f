"""Frontend drivers, one module per entry point of the program, named by
a configuration's `frontend`. `setup(desc, config, workdir, device,
spans)` enters the scene description the way that entry point's users
do, records its set-up phases in `spans` (seconds) and returns a driver:
`unit()` runs one unit of work (an image, a frame) to its end on the
device, `samples_per_unit`, `calls` (host-clock times the driver takes
of its own calls, by name, one per unit), `forget()` drops what the
warm-up unit left, `outputs()` gives the images the window produced
(`images`, each [H, W, 3], one a unit or one for all) and the samples
each holds (`held`), for the check, and `close()` lets go of the
program's state."""
