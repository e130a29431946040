SELECT SUM("ResolutionWidth") AS s0, SUM("ResolutionWidth" + 1) AS s1,
       SUM("ResolutionWidth" + 2) AS s2, SUM("ResolutionWidth" + 3) AS s3,
       SUM("ResolutionWidth" + 4) AS s4
FROM hits
