"""The plain reference of a GPR-MQCLE trajectory's tick, reoptimization and
observables, in plain PyTorch on any device and in any float dtype.

It imports nothing of the program.  The formulas are those of the program's
plain route (the Tully models, the 17-step backward-branching evolver, the
block-diagonal real and complex GP fits, the moment reoptimization and the
observables), written again from the equations: the complex fit as its two
independent real systems at corr = 0 and as the coupled (2N, 2N) joint
system otherwise (:mod:`.coupled`), the inverses through
``cholesky_inverse``; and the constrained ladder's loss, averages,
constraints and gradients (:mod:`.ladder`), its diagonal pass and, with the
coherence active, its full pass.  It covers the settings the benchmark's
cells run: the moment optimizer, the ladder, raw-mean and cutoff
evolution, no booster.
"""
