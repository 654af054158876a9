"""The paper's tables on the port (the reference's ``benchmarks/``):
``common`` (the shared bench model, trained by the port itself, and its
sets) and ``table1_main`` (Table 1)."""
