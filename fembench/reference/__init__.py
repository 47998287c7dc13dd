"""Plain float64 references of the benchmark's solves: NumPy and plain torch
only, nothing of the program under test.

A configuration file (``fembench/configs/<name>.json``) names its reference
module with the key ``"reference"``: ``fembench/reference/<module>.py``, and
``multigrid`` where the key is absent.  ``harness.reference`` resolves it;
the harness, the comparison (``check.Judge``) and the control reach a
reference through that function alone.  A module gives:

- ``build(config, device="cpu", outer_dtype=torch.float64,
  level_dtype=torch.float64)``: ``(outer, V)``, the outer operator and the
  V-cycle of the configuration (``config``: the file's ``"config"``, the
  published JSON as run), each with ``vmult`` on (n,) vectors in the
  reference's numbering; a configuration option it does not implement
  raises ``ValueError``;
- ``cg(A, b, M, rel_tol)``: ``(x, iterations, converged, residuals)`` of
  preconditioned CG from zero (the control solves with it);
- ``n_dofs(config)``: the number of DoFs of the finest level;
- ``lattice(config)``: ``(cells, degree)`` where the reference numbers its
  DoFs as the GLL-node lattice of ``cells`` = (Cx, Cy, Cz) cells of degree
  ``degree`` on a box, x fastest, as the program's structured meshes do:
  the traffic is then made on that lattice and no numbering is matched;
  ``None`` otherwise;
- ``points(config)``: ``(support, free, unit)`` in the reference's
  numbering: the (n, 3) physical support points of the DoFs, the (n,) bool
  mask of the DoFs that are not Dirichlet-constrained, and the (n, 3)
  coordinates in the unit box [0, 1]³ at which the traffic's modes are
  evaluated.  Needed where ``lattice`` gives ``None``: the harness then
  matches the program's support points to ``support`` once at set-up
  (``harness.match_points``) and makes the right-hand sides at ``unit``,
  zero where ``free`` is false.
"""
