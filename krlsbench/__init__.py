"""krlsbench: the driver benchmark of ``bigkrls_tpu_torch`` on CUDA cards.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) for a fixed number of seconds and checks what it produced
against the plain float64 reference in ``reference/``:

    python3 -m krlsbench.run --workload NAME --seed N --seconds S --trace 0|1

A configuration is a file under ``configs/`` (its data a recipe under
``recipes/``), a traffic mix a file under ``traffic/`` (its kind of loop
and check a module under ``kinds/``) and a metric a reader under
``metrics/``, each found by the name ``BENCHMARK.json`` or the file above
it gives it. Nothing here imports JAX or the JAX
package; the reference imports nothing of the program.
"""
