"""The plain reference of the benchmark: D-FINE's model, decode,
postprocess, criterion, matcher and optimizer in plain PyTorch (fp32, TF32
off), a frozen copy of the program's modules with the deformable core as
``grid_sample`` arithmetic and the assignment solved by scipy. It imports
nothing of the program, and takes from the run only the seeded weights
and inputs that the benchmark made."""
