"""CLI alias: `python -m recalgorithm_tpu_torch.cli.dien` trains DIEN
(``cli.main`` with ``--model DIEN`` preset; every flag of ``cli.main``)."""

from recalgorithm_tpu_torch.cli.main import main

if __name__ == "__main__":
    main(model_name="DIEN")
