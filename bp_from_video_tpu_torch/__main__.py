from bp_from_video_tpu_torch.cli import main

raise SystemExit(main())
