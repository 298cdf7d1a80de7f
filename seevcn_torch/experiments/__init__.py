"""The repo's own SEE experiments on the port: the synthetic
domain-adaptation run and the DET-vs-GT mask-path measurement.

One module a script of ``scripts/``, under the script's name and with its
functions and flags (``python -m seevcn_torch.experiments.<name>``):
``da_generate`` (the source, target and VC sets), ``train_vcn_da`` and
``train_vcn_synthetic`` (VCN training), ``da_experiment`` (``complete``,
``train``, ``eval``), ``da_table`` (the AP table) and
``measure_maskpath_impact``. Every entry point runs on the card unless
``--cpu`` asks for the CPU.
"""
