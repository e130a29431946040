SELECT "WatchID", "ClientIP", COUNT(*) AS c, SUM("IsRefresh") AS r,
       AVG("ResolutionWidth") AS a
FROM hits GROUP BY "WatchID", "ClientIP" ORDER BY c DESC LIMIT 10
