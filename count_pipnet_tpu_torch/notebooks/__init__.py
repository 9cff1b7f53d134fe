"""The port's copies of the analysis notebooks that load trained runs
(the repository's notebooks/): the global explanation
(``main_interp``), the cross-run comparison (``interp_many``), the
interactive explorer (``interp_explorer``) and the prototype maps of a
finished run (``viz_prototype_maps``). matplotlib is imported where a
figure is drawn."""
