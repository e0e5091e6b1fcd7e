"""CLI alias: `python -m recalgorithm_tpu_torch.cli.autoint` trains AutoInt
(``cli.main`` with ``--model AutoInt`` preset; every flag of ``cli.main``)."""

from recalgorithm_tpu_torch.cli.main import main

if __name__ == "__main__":
    main(model_name="AutoInt")
