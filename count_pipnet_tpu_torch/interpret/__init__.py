"""Interpretability of the port: prototype visualisation
(``vis_pipnet``), activation histograms (``histograms``), saliency
(``saliency``, ``interpret_idg``), prediction explanations
(``visualize_prediction``), CUB part purity (``eval_cub_csv``) and the
prototype label and group registry (``enums``)."""
