"""Interpretability of the port: prototype visualisation
(``vis_pipnet``) and activation histograms (``histograms``)."""
