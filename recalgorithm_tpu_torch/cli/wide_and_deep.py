"""CLI alias: `python -m recalgorithm_tpu_torch.cli.wide_and_deep` trains WideAndDeep
(``cli.main`` with ``--model WideAndDeep`` preset; every flag of ``cli.main``)."""

from recalgorithm_tpu_torch.cli.main import main

if __name__ == "__main__":
    main(model_name="WideAndDeep")
